from .image_io import (HardDiskBackend, imread, imwrite,  # noqa: F401
                       list_from_file, resize_pair)
from .parse import (load_python_config, parse_and_backup_config,  # noqa: F401
                    require_config_key, select_device)
from .path import increment_path, mkdir_or_exist, scandir  # noqa: F401
