"""SDXL attention interpolation on the PyTorch port (the play_sdxl_trial.ipynb workflow).

From a local SDXL-family diffusers directory (e.g. playground-v2.5, whose
EDM solver the loader picks from its scheduler config): 28 steps,
``warmup_ratio`` 1.0 by default, as the reference notebook.

Usage:
    python examples/torch_interpolate_sdxl.py /path/to/sdxl-checkpoint \
        [--steps 28] [--size 7] [--warmup 1.0] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("--prompt-a", default="A painting of a mountain lake at dawn")
    ap.add_argument("--prompt-b", default="A painting of a desert canyon at dusk")
    ap.add_argument("--guide", default=None)
    ap.add_argument("--negative", default="")
    ap.add_argument("--steps", type=int, default=28)
    ap.add_argument("--size", type=int, default=7)
    ap.add_argument("--warmup", type=float, default=1.0)
    ap.add_argument("--guidance", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (f32, the plain versions)")
    ap.add_argument("--out", default="out/sdxl_interpolation.png")
    return ap


def main(argv=None):
    import torch

    from aid_tpu_torch.models.loader import load_interpolation_xl_pipeline
    from aid_tpu_torch.utils.images import show_images_horizontally

    args = parser().parse_args(argv)
    place = dict(device="cpu", dtype=torch.float32) if args.device == "cpu" else dict(device=args.device)
    pipe = load_interpolation_xl_pipeline(args.checkpoint, **place)
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    l0, l1 = pipe.generate_latent(gen), pipe.generate_latent(gen)
    images = pipe.interpolate(l0, l1, args.prompt_a, args.prompt_b, guide_prompt=args.guide,
                              negative_prompt=args.negative, size=args.size, num_inference_steps=args.steps,
                              warmup_ratio=args.warmup, guidance_scale=args.guidance)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    show_images_horizontally(images, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
