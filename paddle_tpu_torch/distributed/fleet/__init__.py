"""``paddle.distributed.fleet`` helpers of the port: activation recompute."""
