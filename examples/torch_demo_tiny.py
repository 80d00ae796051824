"""Demo: attention interpolation end to end on the PyTorch port, with a tiny random-weight model.

Exercises the port's public API the way a user would (pipeline
construction, AID and PAID interpolation, ``interpolate_single``, the
denoising-interpolation baseline) and writes PNG strips. With a real
diffusers checkpoint the same calls give real interpolations
(``aid_tpu_torch.models.loader.load_interpolation_pipeline``).

Usage:
    python examples/torch_demo_tiny.py                 # on the GPU (the kernels)
    python examples/torch_demo_tiny.py --device cpu    # the plain PyTorch versions
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out", help="directory for the PNG strips")
    return ap


def build_pipeline(device="cuda", seed=0):
    """The tiny SD1.x-like pipeline (TINY_UNET, TINY_VAE, TINY_CLIP_TEXT,
    a hash tokenizer, DDIM), every weight from torch's default init under
    ``seed``, in f32 on ``device``."""
    import torch

    from aid_tpu_torch.models import configs
    from aid_tpu_torch.models.clip import CLIPTextModel
    from aid_tpu_torch.models.unet import UNet2DCondition
    from aid_tpu_torch.models.vae import AutoencoderKL
    from aid_tpu_torch.pipelines.interpolation import InterpolationPipeline
    from aid_tpu_torch.schedulers.ddim import DDIMScheduler
    from aid_tpu_torch.utils.tokenizer import HashTokenizer

    torch.manual_seed(seed)
    return InterpolationPipeline(
        unet=UNet2DCondition(configs.TINY_UNET, device=device).eval(),
        vae=AutoencoderKL(configs.TINY_VAE, device=device).eval(),
        text_encoder=CLIPTextModel(configs.TINY_CLIP_TEXT, device=device).eval(),
        tokenizer=HashTokenizer(configs.TINY_CLIP_TEXT.vocab_size),
        scheduler=DDIMScheduler(),
        vae_scale_factor=2,
    )


def save_strip(images, path):
    from aid_tpu_torch.utils.images import show_images_horizontally

    show_images_horizontally(images, path, upscale=8)
    print(f"wrote {path}  ({len(images)} frames)", flush=True)


def main(argv=None):
    import torch

    args = parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    pipe = build_pipeline(args.device, args.seed)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    l0, l1 = pipe.generate_latent(gen), pipe.generate_latent(gen)

    print("== AID interpolation, the whole sequence in one batch ==", flush=True)
    seq = pipe.interpolate(l0, l1, "a photo of a cat", "a photo of a dog", size=7,
                           num_inference_steps=args.steps)
    save_strip(seq, os.path.join(args.out, "aid_sequence.png"))

    print("== PAID (guide prompt) ==", flush=True)
    paid = pipe.interpolate(l0, l1, "a photo of a cat", "a photo of a dog", guide_prompt="an animal portrait",
                            size=5, num_inference_steps=args.steps)
    save_strip(paid, os.path.join(args.out, "paid_sequence.png"))

    print("== 3-frame interpolate_single ==", flush=True)
    tri = pipe.interpolate_single(0.5, l0, l1, "a cat", "a dog", num_inference_steps=args.steps)
    save_strip(tri, os.path.join(args.out, "single.png"))

    print("== denoising-interpolation baseline ==", flush=True)
    base = pipe.denoising_interpolate(pipe.generate_latent(gen), "a cat", "a dog", interpolated_ratio=0.5,
                                      timesteps=args.steps)
    save_strip(base, os.path.join(args.out, "denoising_baseline.png"))
    print("done.", flush=True)
    return {"aid_sequence": seq, "paid_sequence": paid, "single": tri, "denoising_baseline": base}


if __name__ == "__main__":
    main()
