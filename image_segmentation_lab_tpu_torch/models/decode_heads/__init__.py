from .aspp_head import ASPPHead  # noqa: F401
from .fcn_head import FCNHead  # noqa: F401
from .setr_up_head import SETRUPHead  # noqa: F401
