"""Model families of the port: GPT-2, MoE GPT-2, llama and BERT, trained and
served (BERT serves its logits only); the stable-diffusion stack served
(``clip`` the CLIP text tower, ``diffusion`` the UNet and the VAE); and
``simple``'s SimpleModel for tests."""
