"""Utilities of the port: synthesized FM captures with known ground truth
(``synth``) and the signal-quality metrics they are held to
(``metrics``); test-signal generators (``gen``) and gnuplot dumps
(``logfiles``); stage timing, the per-arm profile and the MAC model
(``profiling``); PSD and constellation plots (``plotting``) and the
per-block PSD animation (``anim``), which import matplotlib when called."""
