from .data_parallel import DataParallelTrainer

__all__ = ["DataParallelTrainer"]
