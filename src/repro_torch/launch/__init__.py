"""The port's launchers and launch-side analysis (counterpart of
:mod:`repro.launch`): ``serve`` and ``train``, the production and host
meshes (``mesh``), the step builders (``steps``) and the roofline (the
LM cells' three-term analysis and the AQP kernels' bandwidth bound)."""
