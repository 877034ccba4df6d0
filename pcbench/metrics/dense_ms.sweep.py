"""Device ms, per 1,000 masked cloud forwards, of every kernel of the sweep
but K4's forward: the ST's Linear GEMMs and elementwise passes
(``nn/models.py``, ``nn/attention.py``), the masks and the counts."""
from pcbench.metrics import device_s, present
from pcbench.trace import kernel_base

K4 = {"mha_fwd_kernel", "mha_fwd_short_kernel", "mha_fwd_merge_kernel"}


def read(ctx):
    tr = ctx.trace
    if not present(tr, K4) or not ctx.counts["clouds"]:
        return None
    rest = {kernel_base(n) for n, _, _ in tr.kernels} - K4
    return 1e3 * device_s(tr, rest) / (ctx.counts["clouds"] / 1000.0)
