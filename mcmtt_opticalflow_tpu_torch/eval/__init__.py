"""Sub-package of mcmtt_opticalflow_tpu_torch; see the module files."""
