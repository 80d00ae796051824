"""Host-side utilities of the PyTorch port.

Exports what ``aid_tpu.utils`` exports, under the same names; the FLOP
counter is ``aid_tpu_torch.utils.flops``, as the JAX package's is
``aid_tpu.utils.flops``.
"""

from aid_tpu_torch.utils.images import (
    image_grids,
    load_and_process_images,
    save_image,
    show_images_horizontally,
    to_pil,
)
from aid_tpu_torch.utils.profiling import PhaseTimer, trace
from aid_tpu_torch.utils.tokenizer import CLIPBPETokenizer, HashTokenizer, load_tokenizer

__all__ = [
    "image_grids",
    "load_and_process_images",
    "save_image",
    "show_images_horizontally",
    "to_pil",
    "PhaseTimer",
    "trace",
    "CLIPBPETokenizer",
    "HashTokenizer",
    "load_tokenizer",
]
