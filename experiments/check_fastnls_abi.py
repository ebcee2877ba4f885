"""Cross-validate the from-scratch C++ fast-NLS against the REFERENCE'S
own ctypes wrapper contract.

The reference links an external ``single_pitch.so`` the user must build
themselves (``others/README.md:11``) through hand-declared ctypes
signatures (``tetralith/jobs/fastf0nls.py:24-41``).  The repo's C++
implementation (``chirpgp_tpu/ops/native/fast_nls.cpp``) exports the same
C ABI, so the reference's wrapper -- reproduced here verbatim as an
interface SPEC (argtypes/restypes + default nFftGrid=5*N*L + est
semantics, ``fastf0nls.py:24-113``) -- must load our ``libfast_nls.so``
and produce estimates identical to the repo's own wrapper
(``chirpgp_tpu/baselines/fastnls.py``).

This closes the last undocumented native-baseline gap: the reference's fastF0Nls column cannot be regenerated in this
environment (its .so is not vendored and there is no network egress), but
the wrapper CONTRACT -- what a reference user's driver code would call --
is validated end-to-end against our native implementation.

    python experiments/check_fastnls_abi.py        # exit 0 on agreement
"""

# Allow running straight from a source checkout (no pip install).
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import ctypes
import math
import sys
from ctypes import c_void_p, c_double, c_int

import numpy as np

ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
LIBPATH = _os.path.join(ROOT, "chirpgp_tpu/ops/native/libfast_nls.so")


def load_via_reference_declarations():
    """Load OUR .so exactly the way the reference's driver does
    (``tetralith/jobs/fastf0nls.py:24-41``): cdll.LoadLibrary plus
    hand-declared argtypes/restypes.  Any ABI mismatch (argument order,
    calling convention, return type) shows up as garbage estimates or a
    crash here."""
    lib = ctypes.cdll.LoadLibrary(LIBPATH)
    lib.single_pitch_new.argtypes = [c_int, c_int, c_int, c_void_p]
    lib.single_pitch_new.restype = c_void_p
    lib.single_pitch_est.argtypes = [c_void_p, c_void_p, c_double, c_double]
    lib.single_pitch_est.restype = c_double
    lib.single_pitch_est_fast.argtypes = [c_void_p, c_void_p, c_double,
                                          c_double]
    lib.single_pitch_est_fast.restype = c_double
    lib.single_pitch_del.argtypes = [c_void_p]
    lib.single_pitch_del.restype = None
    lib.single_pitch_model_order.argtypes = [c_void_p]
    lib.single_pitch_model_order.restype = int
    return lib


class ReferenceStyleSinglePitch:
    """The reference's wrapper class semantics (``fastf0nls.py:43-113``):
    default nFftGrid = 5 * nData * maxModelOrder; est() dispatches to
    est_fast for method==0, est otherwise; returns rad/sample."""

    def __init__(self, lib, nData, maxModelOrder, pitchBounds,
                 nFftGrid=None):
        if nFftGrid is None:
            nFftGrid = 5 * nData * maxModelOrder
        self._lib = lib
        bounds = np.ascontiguousarray(pitchBounds, dtype=np.float64)
        self.obj = lib.single_pitch_new(maxModelOrder, nFftGrid, nData,
                                        bounds.ctypes.data)

    def est(self, data, lnBFZeroOrder=0.0, eps=1e-3, method=0):
        buf = np.ascontiguousarray(data, dtype=np.float64)
        if method == 0:
            return self._lib.single_pitch_est_fast(
                self.obj, buf.ctypes.data, lnBFZeroOrder, eps)
        return self._lib.single_pitch_est(self.obj, buf.ctypes.data,
                                          lnBFZeroOrder, eps)

    def modelOrder(self):
        return self._lib.single_pitch_model_order(self.obj)

    def __del__(self):
        try:
            self._lib.single_pitch_del(self.obj)
        except Exception:
            pass


def main():
    from chirpgp_tpu.baselines.fastnls import single_pitch as ours

    lib = load_via_reference_declarations()

    # The reference driver's harmonic-track operating point
    # (``fastf0nls.py:123-141``): N=300 windows, overlap 295,
    # f0 in [2, 15] Hz at fs=1000, eps=1e-7, method=1.
    fs = 1000.0
    N, L = 300, 3
    bounds = np.array([2.0, 15.0]) / fs

    ref_sp = ReferenceStyleSinglePitch(lib, N, L, bounds)
    our_sp = ours(N, L, bounds)

    n_seeds, n_windows_checked = 3, 12
    max_diff = 0.0
    n_checked = 0
    for mag in ("const", "damped", "random"):
        data = np.load(_os.path.join(ROOT,
                                     f"results/data/toydata_h3_{mag}.npz"))
        for s in range(n_seeds):
            ys = np.asarray(data["ys"][s], dtype=np.float64)
            step = 5 * (len(ys) - N) // (5 * n_windows_checked)
            for k in range(n_windows_checked):
                chunk = ys[k * step:k * step + N]
                for method in (0, 1):
                    a = ref_sp.est(chunk, eps=1e-7, method=method)
                    b = our_sp.est(chunk, eps=1e-7, method=method)
                    mo_a = ref_sp.modelOrder()
                    mo_b = our_sp.modelOrder()
                    d = abs(a - b)
                    max_diff = max(max_diff, d)
                    n_checked += 1
                    if d != 0.0 or mo_a != mo_b:
                        print(f"MISMATCH mag={mag} seed={s} win={k} "
                              f"method={method}: ref-wrapper {a} "
                              f"(order {mo_a}) vs ours {b} (order {mo_b})")

    print(f"checked {n_checked} (window, method) estimates across "
          f"{3 * n_seeds} seed records: max |diff| = {max_diff} rad/sample")
    # Same .so behind both wrappers: agreement must be exact -- anything
    # else means the ctypes contract (argtypes/defaults) diverges.
    ok = max_diff == 0.0
    print("ABI contract", "OK" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
