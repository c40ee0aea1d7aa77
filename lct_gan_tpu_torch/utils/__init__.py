from lct_gan_tpu_torch.utils.config import (append_csv_row, ensure_dir,
                                            now_timestamp, to_jsonable,
                                            write_json)
from lct_gan_tpu_torch.utils.device import (disable_tf32,
                                            gpu_name_and_power_limit,
                                            resolve_device)

__all__ = ["append_csv_row", "disable_tf32", "ensure_dir",
           "gpu_name_and_power_limit", "now_timestamp", "resolve_device",
           "to_jsonable", "write_json"]
