from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .init_functions import init_weights  # noqa: F401
from .seed_init import (derive_seed, init_random_seed,  # noqa: F401
                        set_random_seed)
from .weight_init import (dump_init_info, get_init_info,  # noqa: F401
                          initialize, initialize_from_network_cfg,
                          reset_init_info)
