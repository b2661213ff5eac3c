"""Distribution of the port: logical-axis sharding rules on a DeviceMesh,
gradient compression, fault-tolerance primitives."""
from repro_torch.distributed import sharding  # noqa: F401
