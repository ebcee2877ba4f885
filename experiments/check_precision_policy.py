"""Check the package's matmul-precision policy on the card.

Under XLA's ``default``, ``high`` and ``highest`` matmul precision, in one
process, this measures

- the CKFS seed-0 accuracy gate (``bench.accuracy_gate_rmse_x10``: the
  fused float32 filter+smoother estimate at the reference's learnt
  optimum; float64 reads IF RMSE x10 = 0.776, the bound is 0.80), and
- the relative error of one record's float32 filter NLL and gradient at
  the MLE init point against float64 (``chip_smoke.nll_grad_rel_errors``),

prints the card's name and power limit and one line per setting, and
exits 0 iff the package's own setting passes all three bounds.  On a GPU,
``default`` and ``high`` allow TF32 for float32 matrix products;
``highest`` does not.  A CPU computes float32 products exactly at every
setting, so the script refuses to run without a GPU:

    python experiments/check_precision_policy.py
"""

# Allow running straight from a source checkout (no pip install).
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import numpy as np

import chip_smoke
from bench import (ACC_GATE, accuracy_gate_rmse_x10,
                   gpu_name_and_power_limit, require_gpu)


def main():
    package = jax.config.jax_default_matmul_precision or "default"
    dev = require_gpu()
    print(f"nvidia-smi: {gpu_name_and_power_limit()}")
    print(f"device {dev.platform} {dev.device_kind}; package precision "
          f"{package!r}; bounds: gate RMSE x10 <= {ACC_GATE}, NLL rel <= "
          f"{chip_smoke.TOL_NLL_REL}, gradient rel <= "
          f"{chip_smoke.TOL_GRAD_REL}")
    data = np.load(_os.path.join(chip_smoke.DATA, "toydata_const.npz"))
    theta = chip_smoke.FIT_CFG.default_init_theta()
    passed = {}
    for prec in ("default", "high", "highest"):
        with jax.default_matmul_precision(prec):
            gate = accuracy_gate_rmse_x10()
            nll_rel, grad_rel = chip_smoke.nll_grad_rel_errors(
                theta, data["ys"][0])
        passed[prec] = (gate <= ACC_GATE and nll_rel <= chip_smoke.TOL_NLL_REL
                        and grad_rel <= chip_smoke.TOL_GRAD_REL)
        print(f"  {prec:8s} gate RMSE x10 = {gate:.4f}  NLL rel = "
              f"{nll_rel:.3g}  gradient rel = {grad_rel:.3g}  "
              f"{'pass' if passed[prec] else 'FAIL'}")
    print(f"package setting {package!r}: "
          f"{'OK' if passed[package] else 'FAIL'}")
    _sys.exit(0 if passed[package] else 1)


if __name__ == "__main__":
    main()
