from .parse import (load_python_config, parse_and_backup_config,  # noqa: F401
                    require_config_key)
