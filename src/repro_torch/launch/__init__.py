"""Launch-side analysis of the port (counterpart of :mod:`repro.launch`):
for now the AQP kernels' bandwidth roofline only."""
