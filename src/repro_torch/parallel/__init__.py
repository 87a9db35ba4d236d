"""Multi-device deployment of the port: the stage-cost planning of
``pipeline.py`` (LMs, analytic only), the BCNN's stage-pipelined forward
(``bcnn_pipeline.py``) and its data-parallel bulk forward
(``bcnn_data_parallel.py``), both over a plain list of torch devices."""
