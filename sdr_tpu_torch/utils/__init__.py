"""Utilities of the port: synthesized FM captures with known ground truth
(``synth``)."""
