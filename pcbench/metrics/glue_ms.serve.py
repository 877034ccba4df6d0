"""Device ms a batch of the serving path's device work outside K1-K3: the
log-magnitude, the coordinates, the stack, the chunk mean and the logits'
copy to the host."""
from pcbench.metrics import device_s, present
from pcbench.trace import kernel_base

K3 = {"trim_bounds_kernel", "frames_mag2_kernel"}
K2 = {"topk_chunks_kernel"}
K1 = {"fused_st_kernel", "fused_st_scratch_kernel"}


def read(ctx):
    tr = ctx.trace
    if present(tr, K3) != K3 or not present(tr, K2) or not present(tr, K1):
        return None
    rest = {kernel_base(n) for n, _, _ in tr.kernels} - K1 - K2 - K3
    return 1e3 * device_s(tr, rest) / ctx.counts["batches"]
