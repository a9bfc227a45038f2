"""HF and diffusers checkpoint loaders of the port (``hf``): the vision
part of ``deepspeed_tpu/module_inject``; the language-model loaders are a
later slice of the port."""
