"""Plain PyTorch references of the benchmark's model families, one
module a family (``configs/<config>.json`` names it under
``"reference"``). They import nothing of the program."""
