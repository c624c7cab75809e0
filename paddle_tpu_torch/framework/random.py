"""``paddle.framework.random``: the RNG-state surface (counterpart of
``paddle_tpu/framework/random.py``). All state is the port's functional key
registry (``core.rng``): the "CUDA" state is the same global key."""
from ..core.rng import get_rng_state, get_rng_state_tracker, set_rng_state

__all__ = ["get_rng_state", "set_rng_state", "get_rng_state_tracker",
           "get_cuda_rng_state", "set_cuda_rng_state"]


def get_cuda_rng_state():
    """The global key (one key registry for every device)."""
    return get_rng_state()


def set_cuda_rng_state(state):
    return set_rng_state(state)
