from .io import CheckpointCorrupt, load_checkpoint, save_checkpoint, validate_checkpoint
from .manager import CheckpointManager
from .resume import CheckpointRecord, ResumePlan, plan_resume, scan_checkpoints
from .retention import RetentionPolicy

__all__ = [
    "CheckpointCorrupt",
    "CheckpointManager",
    "CheckpointRecord",
    "ResumePlan",
    "RetentionPolicy",
    "load_checkpoint",
    "plan_resume",
    "save_checkpoint",
    "scan_checkpoints",
    "validate_checkpoint",
]
