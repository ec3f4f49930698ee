"""Command-line drivers: ``cnf-conv`` (``drivers/conv.py``) and ``cnf-eval``
(``drivers/evaluate.py``), run as ``python -m
arl_conditional_normalizing_flows_tpu_torch.drivers.<name>``."""
