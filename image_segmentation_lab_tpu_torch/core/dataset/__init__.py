from .cityscapes import CityscapesDataset  # noqa: F401
from .custom import CustomDataset  # noqa: F401
from .kvasir_seg import KvasirSegDataset  # noqa: F401
from .loader import DataLoader  # noqa: F401
from .standard_datasets import (ADE20KDataset, COCOStuffDataset,  # noqa: F401
                                ChaseDB1Dataset, DRIVEDataset, HRFDataset,
                                LoveDADataset, PascalVOCDataset,
                                PotsdamDataset, STAREDataset,
                                VaihingenDataset, iSAIDDataset)
from .synthetic import SyntheticDataset, make_synthetic_item  # noqa: F401
