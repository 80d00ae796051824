"""Gradio web UI for attention interpolation, on the PyTorch port.

Counterpart of ``aid_tpu.apps.gradio_app`` (the reference's
gradio_src/app.py):
  * a model switcher with per-model defaults applied on switch (guidance
    and steps; SD variants load with UniPC at guidance 10, SDXL with its
    checkpoint's scheduler)
  * the Beta-PPF coefficient-schedule preview plot
  * the examples gallery
  * ``ENABLE_CPU_OFFLOAD=1``: the user asks for the CPU; the pipelines then
    load with ``device="cpu"`` in f32 and run the plain PyTorch versions
    (without it every module is on the card and runs the kernels)
  * ``generate()`` runs ONE ``interpolate`` call for the whole sequence
  * controls: size 3-15, alpha, beta, warmup ratio, guidance scale, steps,
    early/late method, seed, same latent

gradio is imported inside :func:`build_app`, which raises a clear
``ImportError`` where it is not installed; the examples, defaults and plot
data import without it.
Run: python -m aid_tpu_torch.apps.gradio_app /path/to/diffusers-checkpoint
"""

from __future__ import annotations

import os
import sys

from aid_tpu_torch.ops.interp import generate_beta_schedule

EARLY_CHOICES = ["fused_outer", "pure_outer", "fused_inner", "pure_inner"]
LATE_CHOICES = ["self"] + EARLY_CHOICES

ENABLE_CPU_OFFLOAD = os.getenv("ENABLE_CPU_OFFLOAD") == "1"

# Per-model defaults applied when the switcher changes (reference
# change_model_fn app.py:65-87).
MODEL_DEFAULTS = {
    "sd15": {"guidance": 10.0, "steps": 25, "scheduler": "unipc", "size_px": 512},
    "sd21": {"guidance": 10.0, "steps": 25, "scheduler": "unipc", "size_px": 768},
    "sdxl": {"guidance": 5.0, "steps": 28, "scheduler": "auto", "size_px": 1024},
}


def model_defaults(name: str) -> dict:
    return MODEL_DEFAULTS.get(name, MODEL_DEFAULTS["sd15"])


def get_examples():
    """The reference's examples gallery (gradio_src/app.py:115-186),
    columns: [prompt1, prompt2, guide_prompt, negative_prompt, model, size,
    alpha, beta, warmup_ratio, guidance, steps, early, late, seed,
    same_latent]."""
    neg = "monochrome, lowres, bad anatomy, worst quality, low quality"
    neg_xl = "photo, photorealistic, realism, ugly, messy background"
    return [
        ["A photo of dog, best quality, extremely detailed",
         "A photo of car, best quality, extremely detailed",
         "A car with dog furry texture, best quality, extremely detailed",
         neg, "sd15", 3, 6.0, 3.0, 6.1 / 50, 10.0, 50, "fused_inner", "self", 1002, True],
        ["A photo of dog, best quality, extremely detailed",
         "A photo of car, best quality, extremely detailed",
         "A toy named dog-car, best quality, extremely detailed",
         neg, "sd15", 7, 8.0, 8.0, 8.1 / 50, 10.0, 50, "fused_inner", "self", 1002, True],
        ["anime artwork a Pikachu sitting on the grass, dramatic, anime style, "
         "key visual, vibrant, studio anime, highly detailed",
         "anime artwork a beautiful girl, dramatic, anime style, key visual, "
         "vibrant, studio anime, highly detailed",
         None, neg_xl, "sdxl", 7, 10.0, 6.0, 0.5, 10.0, 50, "fused_outer", "self", 1002, False],
        ["vaporwave synthwave style Los Angeles street. cyberpunk, neon, vibes, "
         "stunningly beautiful, crisp, detailed, sleek, ultramodern, high "
         "contrast, cinematic composition",
         "cinematic film still, stormtrooper taking aim. shallow depth of "
         "field, vignette, highly detailed, high budget Hollywood movie, "
         "bokeh, cinemascope, moody, epic, gorgeous, film grain",
         None, neg_xl, "sdxl", 7, 530.0, 602.0, 0.5, 10.0, 50, "fused_outer", "self", 1002, False],
    ]


def beta_plot_data(size: int, alpha: float, beta: float):
    ts = generate_beta_schedule(int(size), float(alpha), float(beta), force_endpoints=True)
    return {"x": list(range(len(ts))), "y": [float(t) for t in ts]}


def seeded_latent(pipe, seed: int):
    """The pipeline's (1, C, h, w) latent from a generator seeded with
    ``seed`` on the pipeline's device."""
    import torch

    return pipe.generate_latent(torch.Generator(device=pipe.device).manual_seed(int(seed)))


def build_app(pipeline_factory):
    """``pipeline_factory(model_name)`` -> an ``InterpolationPipeline`` (or
    its SDXL subclass); the last one built is kept until the model changes."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("gradio is not installed in this environment; install it to run the app "
                          "(the rest of aid_tpu_torch does not need it)") from e

    from aid_tpu_torch.utils.images import to_pil

    state = {"name": None, "pipe": None}

    def get_pipe(model_name):
        if state["name"] != model_name:
            state["pipe"] = pipeline_factory(model_name)
            state["name"] = model_name
        return state["pipe"]

    def generate(model_name, prompt1, prompt2, guide_prompt, negative_prompt, size, alpha, beta, warmup_ratio,
                 guidance, steps, early, late, seed, same_latent):
        pipe = get_pipe(model_name)
        l0 = seeded_latent(pipe, seed)
        l1 = l0 if same_latent else seeded_latent(pipe, int(seed) + 1)
        images = pipe.interpolate(
            l0, l1, prompt1, prompt2,
            guide_prompt=guide_prompt or None,
            negative_prompt=negative_prompt or "",
            size=int(size), num_inference_steps=int(steps),
            warmup_ratio=float(warmup_ratio), early=early, late=late,
            alpha=float(alpha), beta=float(beta),
            guidance_scale=float(guidance),
        )
        return to_pil(images)

    with gr.Blocks(title="AID/PAID on the GPU") as demo:
        gr.Markdown("# Attention Interpolation (AID/PAID), PyTorch and CUDA")
        model = gr.Dropdown(list(MODEL_DEFAULTS), value="sd15", label="Model")
        with gr.Row():
            prompt1 = gr.Textbox(label="Prompt A")
            prompt2 = gr.Textbox(label="Prompt B")
        guide = gr.Textbox(label="Guidance prompt (PAID, optional)")
        negative = gr.Textbox(label="Negative prompt")
        with gr.Row():
            size = gr.Slider(3, 15, value=7, step=1, label="Interpolation size")
            alpha = gr.Slider(0.1, 700, value=25, label="alpha")  # examples go up to 602
            beta = gr.Slider(0.1, 700, value=25, label="beta")
        with gr.Row():
            warmup = gr.Slider(0.0, 1.0, value=0.5, label="Warmup ratio")
            guidance = gr.Slider(1.0, 15.0, value=10.0, label="Guidance scale")
            steps = gr.Slider(5, 50, value=25, step=1, label="Inference steps")
        with gr.Row():
            early = gr.Dropdown(EARLY_CHOICES, value="fused_outer", label="Early method")
            late = gr.Dropdown(LATE_CHOICES, value="self", label="Late method")
            seed = gr.Number(value=0, label="Seed")
            same_latent = gr.Checkbox(value=False, label="Same latent")
        plot = gr.LinePlot(x="x", y="y", label="Beta schedule preview")
        for ctl in (size, alpha, beta):
            ctl.change(beta_plot_data, [size, alpha, beta], plot)

        def on_model_change(name):
            d = model_defaults(name)
            return gr.update(value=d["guidance"]), gr.update(value=d["steps"])

        model.change(on_model_change, [model], [guidance, steps])

        gallery = gr.Gallery(label="Interpolation sequence")
        btn = gr.Button("Generate")
        inputs = [model, prompt1, prompt2, guide, negative, size, alpha, beta,
                  warmup, guidance, steps, early, late, seed, same_latent]
        btn.click(generate, inputs, gallery)
        gr.Examples(
            examples=[list(e) for e in get_examples()],
            inputs=[prompt1, prompt2, guide, negative, model, size, alpha,
                    beta, warmup, guidance, steps, early, late, seed, same_latent],
            label="Examples (reference gallery)",
        )
    return demo


def pipeline_factory(root: str, cpu: bool = ENABLE_CPU_OFFLOAD):
    """The app's loader: ``name -> pipeline`` from the diffusers directory
    ``root`` with the model's defaults, every module on the card, or on the
    CPU in f32 where ``cpu`` (``ENABLE_CPU_OFFLOAD=1``) asks for it."""
    import torch

    from aid_tpu_torch.models.loader import load_interpolation_pipeline, load_interpolation_xl_pipeline

    place = dict(device="cpu", dtype=torch.float32) if cpu else {}

    def factory(name):
        d = model_defaults(name)
        if name == "sdxl":
            return load_interpolation_xl_pipeline(root, scheduler_name=d["scheduler"], **place)
        return load_interpolation_pipeline(root, scheduler_name=d["scheduler"], guidance_scale=d["guidance"], **place)

    return factory


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    build_app(pipeline_factory(argv[0])).launch()


if __name__ == "__main__":
    main()
