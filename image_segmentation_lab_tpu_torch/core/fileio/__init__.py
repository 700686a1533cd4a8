from .image_io import (HardDiskBackend, imread,  # noqa: F401
                       list_from_file, resize_pair)
from .parse import (load_python_config, parse_and_backup_config,  # noqa: F401
                    require_config_key)
