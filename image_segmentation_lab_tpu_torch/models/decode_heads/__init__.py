from .ann_head import AFNB, ANNHead, APNB, PPMConcat  # noqa: F401
from .aspp_head import ASPPHead  # noqa: F401
from .cc_head import CCHead, CrissCrossAttention  # noqa: F401
from .da_head import CAM, DAHead, PAM  # noqa: F401
from .ddr_head import DDRHead  # noqa: F401
from .dnl_head import DisentangledNonLocal2d, DNLHead  # noqa: F401
from .dpt_head import DPTHead  # noqa: F401
from .ema_head import EMAHead, EMAModule  # noqa: F401
from .fcn_head import FCNHead  # noqa: F401
from .fpn_head import FPNHead  # noqa: F401
from .gc_head import ContextBlock, GCHead  # noqa: F401
from .ham_head import Hamburger, LightHamHead, NMF2D  # noqa: F401
from .isa_head import ISAHead  # noqa: F401
from .mask2former_head import Mask2FormerHead  # noqa: F401
from .maskformer_head import MaskFormerHead  # noqa: F401
from .nl_head import NLHead  # noqa: F401
from .pid_head import PIDHead, boundary_from_label  # noqa: F401
from .psa_head import PSAHead, psa_mask  # noqa: F401
from .psp_head import PPM, PSPHead  # noqa: F401
from .segformer_head import SegFormerHead  # noqa: F401
from .segmenter_mask_head import SegmenterMaskTransformerHead  # noqa: F401
from .sep_aspp_head import DepthwiseSeparableASPPHead  # noqa: F401
from .setr_mla_head import SETRMLAHead  # noqa: F401
from .setr_up_head import SETRUPHead  # noqa: F401
from .uper_head import UPerHead  # noqa: F401
