"""The optimizer zoo of the port (``fullbatchtraining_tpu/training/opt/``):
per-step optimizers (:mod:`.lars`, :mod:`.agc`, :mod:`.adaptive_clipping`,
:mod:`.fista`) and the closure drivers (:mod:`.closures`, :mod:`.lbfgs`,
``FISTALineSearchDriver``)."""
