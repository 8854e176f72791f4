from .synthetic import DataConfig, SyntheticTokens  # noqa: F401
