"""The distributed (Nmpi > 1) runtime: a single-controller shard group,
z-slab decomposition and halos, ring-LET gravity and migration."""
