"""Logical-axis sharding rules on ``torch.distributed`` device meshes
(port of ``repro.sharding``)."""
