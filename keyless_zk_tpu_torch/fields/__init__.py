from . import bn254, limbs, torch_field  # noqa: F401
from .torch_field import FQ, FR, FieldSpec  # noqa: F401
