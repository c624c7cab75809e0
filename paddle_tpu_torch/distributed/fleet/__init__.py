"""``paddle.distributed.fleet`` helpers of the port: the tensor-parallel
layers (``meta_parallel``) and activation recompute (``recompute``)."""
