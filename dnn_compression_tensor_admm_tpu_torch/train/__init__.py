from .engine import TrainConfig, eval_runtime, evaluate_model, train_model

__all__ = ["TrainConfig", "eval_runtime", "evaluate_model", "train_model"]
