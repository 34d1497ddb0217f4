"""Sharded execution over torch.distributed (the port of rejit_tpu/dist):
meshes and their collectives (mesh.py), the exact cross-shard DFA routes
(sharded.py) and the bounded-window literal route (literal.py)."""
