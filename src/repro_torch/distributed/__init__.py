"""Distribution layer of the port on a single-controller mesh:
`distributed.sharding` (parameter rules, specs, placement),
`distributed.compression` (bf16 / int8 reductions, error feedback) and
`distributed.collectives` (the sharded engine's merge)."""
