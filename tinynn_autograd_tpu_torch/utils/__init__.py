from tinynn_autograd_tpu_torch.utils.data_iterator import Batch, BaseIterator, BatchIterator
from tinynn_autograd_tpu_torch.utils.seeder import random_seed

__all__ = ["Batch", "BaseIterator", "BatchIterator", "random_seed"]
