"""The drivers of the cells, one module a ``kind`` of cell: ``bench/drivers/<kind>.py``."""
