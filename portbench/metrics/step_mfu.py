"""step_mfu: the whole step's share of the H100's float32 peak, in %.

The model's matmul FLOPs a train step (forward and backward, counted from
the configuration's published widths and `arch_kwargs` by its
architecture's `forward_flops`, `portbench/work.py`), times the
window's steps, over the window's seconds and 67 TFLOP/s (float32 outside
the tensor cores: the configurations keep TF32 off).
"""

from portbench import work


def read(r):
    if not r["cuda"]:
        return None
    w, cell, t = r["window"], r["cell"], r["traffic"]
    flops = work.step_matmul_flops(cell.config["arch"], t["batch"], t["points"],
                                   **cell.config.get("arch_kwargs", {}))
    return 100.0 * flops * w["steps"] / w["seconds"] / work.PEAK_F32_FLOPS
