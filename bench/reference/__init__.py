"""The plain reference: the configuration's transformer in fp32 PyTorch
(no TF32), with no kernel, no cache and no batching, and a lower-precision
twin of it for the controls.  It imports nothing of the port and takes
nothing the port made: it draws the weights and inputs again from the
seed (``bench/harness/inputs.py``)."""
