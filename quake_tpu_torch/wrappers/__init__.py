"""Index wrappers (the counterpart of quake_tpu/wrappers/): one interface
over this package's QuakeIndex and the baselines, and the name registry."""

from quake_tpu_torch.wrappers.wrapper import IndexWrapper, get_index_class

__all__ = ["IndexWrapper", "get_index_class"]
