"""In-repo optimizers for the LM stack (no ``torch.optim``)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, sgdm_init, \
    sgdm_update
from .schedule import cosine_warmup
from .grad_compress import compress_int8, decompress_int8, \
    ErrorFeedbackState, ef_compress_update

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "sgdm_init", "sgdm_update",
    "cosine_warmup", "compress_int8", "decompress_int8",
    "ErrorFeedbackState", "ef_compress_update",
]
