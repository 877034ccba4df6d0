"""K3 (trim and frame pass) and K2 (exact top K) together against the least
bytes of featurize + select: each wave sample of the clips read once, each
valid chunk's selected values (bf16) and indices written once.  An FFT's
operations are left out: their count depends on the algorithm."""
from pcbench import roofline as rf
from pcbench.metrics import device_s, present

KERNELS = {"trim_bounds_kernel": "K3 trim", "frames_mag2_kernel": "K3 frames",
           "topk_chunks_kernel": "K2"}


def read(ctx):
    if present(ctx.trace, KERNELS) != set(KERNELS):
        return None
    nbytes = rf.extract_bytes(ctx.counts["wave_samples"], ctx.counts["valid_clouds"],
                              ctx.config["pipeline"]["top_k"])
    return rf.share_pct(rf.roofline_s(0, nbytes, "bf16"), device_s(ctx.trace, KERNELS))
