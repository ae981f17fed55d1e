"""Distributed-training helpers (port of ``repro/distributed``): gradient
compression and fault tolerance.  The mesh and sharding modules are
ROADMAP port queue item 6b."""
