from pcaudio_torch.utils.debugging import (
    assert_finite_tree, check_jit_purity, collective_calls, enable_nan_debugging)
from pcaudio_torch.utils.metrics import (
    MetricsWriter, dump_reference_json, dump_with_provenance, read_metrics)
from pcaudio_torch.utils.params import count_parameters, named_parameters
from pcaudio_torch.utils.profiling import device_sync, time_fn, trace

__all__ = [
    "count_parameters", "named_parameters",
    "MetricsWriter", "read_metrics", "dump_reference_json",
    "dump_with_provenance",
    "device_sync", "time_fn", "trace",
    "enable_nan_debugging", "assert_finite_tree", "check_jit_purity",
    "collective_calls",
]
