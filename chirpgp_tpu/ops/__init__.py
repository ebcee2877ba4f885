"""Low-level ops: native (C++) components."""
