"""Helpers of the port's serving front end (``metrics``), copied from
``tpu_dra/util``."""
