from .model import DetectionModel, model_config  # noqa: F401
