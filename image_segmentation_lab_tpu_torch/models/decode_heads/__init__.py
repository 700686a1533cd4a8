from .aspp_head import ASPPHead  # noqa: F401
from .fcn_head import FCNHead  # noqa: F401
from .psp_head import PPM, PSPHead  # noqa: F401
from .segformer_head import SegFormerHead  # noqa: F401
from .setr_up_head import SETRUPHead  # noqa: F401
from .uper_head import UPerHead  # noqa: F401
