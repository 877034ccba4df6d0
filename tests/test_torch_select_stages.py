"""K2's stage probe (``pcaudio_torch.probes.k2_stages``) without a build:
its source edits apply to the current ``csrc/select.cu`` and cut it where
they say, and an edit that does not apply raises, naming the missing text."""
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
    # the current source is not the earlier design: its constant is missing
    with pytest.raises(ValueError, match="kSelectThreads = 256"):
        k2_stages.apply_edits(SOURCE, k2_stages.OLD_EDITS[stage], stage)
    with pytest.raises(ValueError, match="kStopAfter = 0"):
        k2_stages.stage_sources(SOURCE.replace("kStopAfter = 0", "kStopAfter = 3"),
                                k2_stages.CURRENT_EDITS, "edited select.cu")


def test_old_edits_cut_after_the_load_and_at_tau():
    anchors = "".join(old for old, _ in k2_stages.OLD_EDITS["load"])
    srcs = k2_stages.stage_sources(anchors, k2_stages.OLD_EDITS, "anchors")
    assert "kStopAfter = 1;" in srcs["load"] and "kStopAfter = 2;" in srcs["tau"]
    for stage in ("load", "tau"):
        assert srcs[stage].count("return;") == 2
