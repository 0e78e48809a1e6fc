"""The plain reference: exact sparse maximum inner product search in
plain PyTorch. It imports nothing of the program and reads nothing the
program made."""
