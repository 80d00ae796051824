"""SD 1.x / 2.x attention interpolation on the PyTorch port (the play_sd.ipynb workflow).

From a local diffusers-format checkpoint directory (no download): the
whole sequence in one ``interpolate`` call (PAID with ``--guide``), or the
dynamic selection (``BetaPriorPipeline``, ``--exploration N``) scored by a
local CLIP vision checkpoint (``--clip``, transformers layout).

Usage:
    python examples/torch_interpolate_sd.py /path/to/stable-diffusion-v1-5 \
        [--clip /path/to/clip-vit-base-patch32 --exploration 16] [--steps 25] [--size 7] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("--clip", help="CLIP vision checkpoint directory for the dynamic selection")
    ap.add_argument("--prompt-a", default="A photo of dog, best quality, extremely detailed")
    ap.add_argument("--prompt-b", default="A photo of car, best quality, extremely detailed")
    ap.add_argument("--guide", default=None, help="PAID guidance prompt")
    ap.add_argument("--negative", default="monochrome, lowres, bad anatomy, worst quality, low quality")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--size", type=int, default=7)
    ap.add_argument("--exploration", type=int, default=0, help=">0: dynamic selection with this budget")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (f32, the plain versions)")
    ap.add_argument("--out", default="out/sd_interpolation.png")
    return ap


def load_clip_scorer(path, device, dtype):
    """A ``feature_fn`` of ``BetaPriorPipeline`` from a transformers CLIP
    directory (a CLIPModel's or a CLIPVisionModelWithProjection's weights;
    the text tower's are left out)."""
    from aid_tpu_torch.models.clip import CLIPVisionModel
    from aid_tpu_torch.models.loader import _placed, _read_config, clip_vision_config_from_transformers
    from aid_tpu_torch.prior.clip_scorer import make_clip_feature_fn
    from aid_tpu_torch.utils.safetensors import load_safetensors

    sd = {k: v for k, v in load_safetensors(path).items() if k.startswith(("vision_model.", "visual_projection."))}
    vision = _placed(CLIPVisionModel, clip_vision_config_from_transformers(_read_config(path)), sd, dtype, device)
    return make_clip_feature_fn(vision)


def main(argv=None):
    import numpy as np
    import torch

    from aid_tpu_torch.models.loader import load_interpolation_pipeline
    from aid_tpu_torch.utils.images import show_images_horizontally

    args = parser().parse_args(argv)
    place = dict(device="cpu", dtype=torch.float32) if args.device == "cpu" else dict(device=args.device)
    pipe = load_interpolation_pipeline(args.checkpoint, **place)
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    l0, l1 = pipe.generate_latent(gen), pipe.generate_latent(gen)

    if args.exploration > 0:
        from aid_tpu_torch.prior.beta import BetaPriorPipeline

        bp = BetaPriorPipeline(pipe, load_clip_scorer(args.clip, pipe.device, torch.float32))
        images = np.stack(bp.generate_interpolation(
            args.prompt_a, args.prompt_b, negative_prompt=args.negative, latent_start=l0, latent_end=l1,
            num_inference_steps=args.steps, exploration_size=args.exploration, interpolation_size=args.size))
    else:
        images = pipe.interpolate(l0, l1, args.prompt_a, args.prompt_b, guide_prompt=args.guide,
                                  negative_prompt=args.negative, size=args.size, num_inference_steps=args.steps)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    show_images_horizontally(images, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
