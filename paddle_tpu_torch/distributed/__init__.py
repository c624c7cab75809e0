"""Distributed helpers of the port (counterpart of
``paddle_tpu.distributed``): the serving mesh (``mesh``), its collectives
(``collective``) and sharding rules (``sharding_util``), the
tensor-parallel layers (``fleet.meta_parallel``), activation recompute
(``fleet.recompute``) and step checkpoints (``checkpoint``)."""
