"""Multi-process training: process groups from the environment
(``multihost``) and the data-parallel step (``data_parallel``)."""
