"""Training of the port: the optimizer recipe (``optim.py``) and the step
factories (``state.py``)."""
