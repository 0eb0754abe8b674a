"""Host-side native code of the port (built with g++ at first use)."""

from quake_tpu_torch.native.idmap import NativeIdMap, native_available

__all__ = ["NativeIdMap", "native_available"]
