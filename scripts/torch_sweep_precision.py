"""How far one float32 sweep of the port lies from the same sweep in
float64, on the CPU: the yardstick for chip_smoke.py's card-against-CPU
sweep check.

    python3 scripts/torch_sweep_precision.py

For C in (2, 5), H in (1, 3) (H = 3 in the GP theta regime) and responses
uniform over 1..C or drawn from the model (chip_smoke.sweep_inputs), runs
the check's tempered (T = 4) float32 sweep and the same sweep with its
state, draws and constants in float64 (chip_smoke.sweep_vs_float64), and
prints the largest difference of each field, and of the z draw with the
cell that sets it.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import DYN_LS, max_diff, sweep_vs_float64  # noqa: E402


def main():
    for C in (2, 5):
        for H in (1, 3):
            for model_y in (False, True):
                (s32, z32), (s64, z64), y, cfg = sweep_vs_float64(
                    C, H=H, theta_ls=DYN_LS if H > 1 else 10.0, model_y=model_y)
                errs = ", ".join(f"{k} {max_diff(getattr(s32, k), getattr(s64, k))[0]:.3g}"
                                 for k in ("f", "beta", "thresholds", "fstar"))
                dz, iz = max_diff(z32["z"], z64["z"])
                print(f"C={C} H={H} ({cfg.theta_regime}), y "
                      f"{'from the model' if model_y else 'uniform'}: theta equal "
                      f"{torch.equal(s32.theta_idx, s64.theta_idx)}; float32 - float64: "
                      f"{errs}; z {dz:.3g} at cell {iz} (g {float(z64['g'][iz]):.4f}, "
                      f"y {int(y[iz[1:]])})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
