"""User-facing apps on the port (the Gradio UI: ``gradio_app``)."""
