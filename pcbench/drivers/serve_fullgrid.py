"""Batch serving of the temporal 3ST on the full grid: the mix's ``top_k``
(null: every bin of each chunk, 5,120 points a cloud, no selection) in
place of the configuration's, so that the program (K3, then K1's scratch
form), the counts and the reference all follow it; set-up, the window and
the release are ``drivers/serve.py``'s, unchanged.  The comparison is
``serve.py``'s too, with the plain reference run on fewer clouds at a time
(``BLOCK``): its scores at 5,120 points would not fit the card in blocks of
4,096 clouds."""
from __future__ import annotations

from pcbench.drivers import serve
from pcbench.drivers.serve import release, window  # noqa: F401
from pcbench.reference.precision import PRECISIONS, tf32_off

BLOCK = 256


def _full_grid(run):
    run.config = {**run.config,
                  "pipeline": {**run.config["pipeline"], "top_k": run.workload["top_k"]}}
    return run


def setup(run):
    return serve.setup(_full_grid(run))


def reference_logits(st, k: int, rnd):
    """The plain reference's clip logits of pool batch ``k``."""
    from pcbench.reference import featurize as rf
    from pcbench.reference.st import st_forward_blocks

    b = st.pool[k]
    clouds, valid = rf.serve_clouds(b["waves"], b["lengths"], st.run.config["pipeline"])
    logits = st_forward_blocks(st.params, clouds, None, st.run.config["model"]["num_heads"],
                               rnd, block=BLOCK)
    return rf.clip_logits(logits, valid).cpu().numpy()


def check(st):
    rnd = PRECISIONS[st.run.config["reference_precision"]]
    with tf32_off():
        refs = {k: reference_logits(st, k, rnd) for k in sorted({k for k, _ in st.outs})}
    gap = max((serve.logit_gap(y, refs[k]) for k, y in st.outs), default=float("inf"))
    return [("logit_gap", gap, st.run.limits["logit_gap"])]


def control(run, precision: str, batches: int = 1):
    """The comparison's reading with the reference at ``precision`` in the
    program's place, on the first ``batches`` pool batches."""
    st = serve.inputs(_full_grid(run))
    rnd = PRECISIONS[run.config["reference_precision"]]
    with tf32_off():
        gaps = [serve.logit_gap(reference_logits(st, k, PRECISIONS[precision]),
                                reference_logits(st, k, rnd)) for k in range(batches)]
    return {"logit_gap": max(gaps)}
