"""The plain side of every check: float32 PyTorch written from the models'
and the recipes' published equations. It imports nothing of the program (the
`pytorch3dunet_tpu_torch` package) and takes nothing the program made."""
