"""The program under test, as the drivers build it: the port's own
objects, from the configuration's sizes and the harness's weights."""
from __future__ import annotations


def build_st(run, params):
    """The port's ``ST`` at the configuration's widths on the run's device,
    holding ``params`` (``weights.st_state_dict``), attention through
    kernel K4 where the configuration says so."""
    from pcaudio_torch.nn import ST

    m = run.config["model"]
    model = ST(dim_input=m["dim_input"], num_outputs=1, dim_output=m["num_classes"],
               num_inds=m["num_inds"], dim_hidden=m["dim_hidden"],
               num_heads=m["num_heads"], fused_attn=m["fused_attn"]).to(run.device)
    model.load_state_dict(params)
    return model
