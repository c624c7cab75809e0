"""Distributed training helpers of the port (counterpart of
``paddle_tpu.distributed``); on one card only activation recompute."""
