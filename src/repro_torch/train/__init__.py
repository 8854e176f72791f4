from .trainer import TrainConfig, Trainer  # noqa: F401
from .server import DecodeServer, Request, Completion  # noqa: F401
