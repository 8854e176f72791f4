from .store import (latest_checkpoint, restore_checkpoint,
                    save_checkpoint)  # noqa: F401
