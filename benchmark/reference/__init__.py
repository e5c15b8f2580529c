"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch modules (each headed by its source file and commit), importing
nothing of the program."""
