"""The port's launchers and launch-side analysis (counterpart of
:mod:`repro.launch`): ``serve`` and ``train``, and for now the AQP
kernels' bandwidth roofline."""
