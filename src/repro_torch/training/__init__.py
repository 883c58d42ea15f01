from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.data_pipeline import SyntheticLMDataset
from repro_torch.training.optimizer import AdamW, cosine_schedule, global_norm
from repro_torch.training.train_step import make_train_step

__all__ = ["AdamW", "cosine_schedule", "global_norm", "make_train_step",
           "save_checkpoint", "restore_checkpoint", "SyntheticLMDataset"]
