from .model import Model, RuntimeFlags
from .convert import params_from_jax

__all__ = ["Model", "RuntimeFlags", "params_from_jax"]
