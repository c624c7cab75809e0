"""``paddle.jit`` for the port (counterpart of ``paddle_tpu.jit``):
``to_static`` and its knobs (:mod:`.static_function`), ``InputSpec``
(:mod:`.input_spec`), ``save`` / ``load`` / ``TranslatedLayer``
(:mod:`.save_load`) and ``TrainStep``, run eagerly
(:mod:`.train_step`)."""
from .input_spec import InputSpec
from .save_load import TranslatedLayer, load, save
from .static_function import (StaticFunction, enable_to_static,
                              ignore_module, not_to_static, set_code_level,
                              set_verbosity, to_static)
from .train_step import TrainStep

__all__ = ["to_static", "StaticFunction", "InputSpec", "save", "load",
           "TranslatedLayer", "not_to_static", "enable_to_static",
           "ignore_module", "set_code_level", "set_verbosity", "TrainStep"]
