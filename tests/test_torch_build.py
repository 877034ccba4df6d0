"""The one builder of the port's CUDA libraries (``ops/kernels/_build.py``)
without nvcc: each library binds exactly the C entry points its sources
define, the path's library holds no probe kernel, and a library's file name
follows its own sources, the shared headers and its sources' flags alone."""
import re
import shutil

import pytest

from pcaudio_torch.ops.kernels import _build, probes

# a C entry point's definition: extern "C", or a line inside an extern "C"
# block, starting with its return type
ENTRY = re.compile(r'^(?:extern "C"\s+)?(?:const\s+)?\w+\*?\s+(pcaudio_\w+)\s*\(', re.M)
LIBRARIES = {"path": (_build.NAME, _build.SOURCES, _build.SIGNATURES),
             "probe": (probes.NAME, probes.SOURCES, probes.SIGNATURES)}


@pytest.mark.parametrize("which", sorted(LIBRARIES))
def test_each_library_binds_what_its_sources_define(which):
    name, sources, signatures = LIBRARIES[which]
    assert all(text is None for text in sources.values())  # csrc/ as it is
    defined = [m for n in sources for m in ENTRY.findall((_build.CSRC / n).read_text())]
    assert len(defined) == len(set(defined))
    assert set(defined) == set(signatures)
    is_probe = [n.startswith("probe_") for n in sources if n != _build.ERROR_SOURCE]
    assert all(is_probe) if which == "probe" else not any(is_probe)
    assert _build.library_path(name, sources).name.startswith(f"lib{name}_")


def test_library_name_hashes_its_own_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)

    def names(flags=_build.SOURCE_FLAGS):
        return tuple(_build.library_path(name, sources, flags)
                     for name, sources, _ in LIBRARIES.values())
    path, probe = names()
    assert path != probe and names() == (path, probe)

    def edit(file):
        with open(csrc / file, "a") as f:
            f.write("\n// an edit\n")
        return names()
    path2, probe2 = edit("probe_mma.cu")
    assert path2 == path and probe2 != probe
    path3, probe3 = edit("common.cuh")
    assert path3 != path2 and probe3 != probe2
    path4, probe4 = edit("mha.cu")
    assert path4 != path3 and probe4 == probe3

    for file, moved in (("probe_stream.cu", "probe"), ("fused_st.cu", "path")):
        flags = {**_build.SOURCE_FLAGS, file: _build.SOURCE_FLAGS.get(file, ()) + ("-G",)}
        got = names(flags)
        assert (got[0] != path4, got[1] != probe4) == (moved == "path", moved == "probe")
