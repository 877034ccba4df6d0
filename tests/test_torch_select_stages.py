"""K2's stage probe (``pcaudio_torch.probes.k2_stages``) without a build:
its source edits apply to the current ``csrc/select.cu`` and cut it where
they say, and an edit that does not apply raises, naming the missing text."""
import re

import pytest

from pcaudio_torch.ops.kernels import _build
from pcaudio_torch.probes import k2_stages

SOURCE = (_build.CSRC / "select.cu").read_text()


def test_current_edits_apply_to_select_cu():
    srcs = k2_stages.stage_sources(SOURCE, k2_stages.CURRENT_EDITS, "select.cu")
    assert set(srcs) == set(k2_stages.STAGES)
    assert srcs["whole"] == SOURCE
    assert "constexpr int kStopAfter = 1;" in srcs["load"]
    assert "constexpr int kStopAfter = 2;" in srcs["tau"]
    assert len(set(srcs.values())) == 3


@pytest.mark.parametrize("stage", ["load", "tau"])
def test_an_edit_that_does_not_apply_names_the_missing_text(stage):
    # a source without the stage's anchor: its stop constant set otherwise
    (anchor, _), = k2_stages.CURRENT_EDITS[stage]
    source = SOURCE.replace(anchor, "constexpr int kStopAfter = 3;")
    assert anchor not in source
    with pytest.raises(ValueError, match=re.escape(anchor.strip())):
        k2_stages.apply_edits(source, k2_stages.CURRENT_EDITS[stage], stage)
    with pytest.raises(ValueError, match=re.escape(anchor.strip())):
        k2_stages.stage_sources(source, k2_stages.CURRENT_EDITS, "edited select.cu")
