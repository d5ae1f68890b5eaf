from . import ref_curve  # noqa: F401
from .field_ops import FQ2_OPS, FQ_OPS  # noqa: F401
from .jacobian import G1_CURVE, G2_CURVE, JacobianCurve, JacPoint  # noqa: F401
