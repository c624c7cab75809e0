"""Distributed training helpers of the port (counterpart of
``paddle_tpu.distributed``); on one card: activation recompute
(``fleet.recompute``) and step checkpoints (``checkpoint``)."""
