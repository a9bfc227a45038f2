"""Model families of the port: GPT-2, MoE GPT-2, llama and BERT, trained and
served (BERT serves its logits only)."""
