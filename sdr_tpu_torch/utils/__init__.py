"""Utilities of the port: synthesized FM captures with known ground truth
(``synth``) and the signal-quality metrics they are held to
(``metrics``)."""
