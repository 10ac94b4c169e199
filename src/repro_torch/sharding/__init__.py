"""Tensor-parallel placement (counterpart of ``repro/sharding``):
``specs`` (parameter, batch and cache placements), ``ctx`` (the process-
global policy) and ``comm`` (the port's written-out collectives)."""
