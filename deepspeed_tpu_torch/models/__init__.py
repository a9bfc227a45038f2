"""Model families of the port: llama (serving) and GPT-2 (training) so far."""
