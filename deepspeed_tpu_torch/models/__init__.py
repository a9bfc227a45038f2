"""Model families of the port (llama so far)."""
