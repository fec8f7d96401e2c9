"""Roofline analysis of the port's dry-run: the collectives a step issues
(``comm``) and the three-term (compute / memory / collective) model over
the NVIDIA H100 SXM's data-sheet peaks (``hw``, ``report``)."""
