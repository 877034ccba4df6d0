from pcaudio_torch.utils.metrics import dump_reference_json, dump_with_provenance

__all__ = ["dump_reference_json", "dump_with_provenance"]
