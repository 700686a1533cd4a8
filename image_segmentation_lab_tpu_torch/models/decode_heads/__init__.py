from .aspp_head import ASPPHead  # noqa: F401
from .ddr_head import DDRHead  # noqa: F401
from .dpt_head import DPTHead  # noqa: F401
from .fcn_head import FCNHead  # noqa: F401
from .fpn_head import FPNHead  # noqa: F401
from .ham_head import Hamburger, LightHamHead, NMF2D  # noqa: F401
from .mask2former_head import Mask2FormerHead  # noqa: F401
from .maskformer_head import MaskFormerHead  # noqa: F401
from .pid_head import PIDHead, boundary_from_label  # noqa: F401
from .psp_head import PPM, PSPHead  # noqa: F401
from .segformer_head import SegFormerHead  # noqa: F401
from .segmenter_mask_head import SegmenterMaskTransformerHead  # noqa: F401
from .setr_mla_head import SETRMLAHead  # noqa: F401
from .setr_up_head import SETRUPHead  # noqa: F401
from .uper_head import UPerHead  # noqa: F401
