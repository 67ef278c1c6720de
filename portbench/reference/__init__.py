"""The benchmark's plain reference: float32 PyTorch, importing nothing of the
program it checks (``model.py`` the forward, ``train.py`` the training
steps, ``lowp.py`` the exact and the control arithmetic)."""
