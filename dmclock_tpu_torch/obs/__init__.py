"""Scheduling observability for the PyTorch port: the on-device metrics
vector and the admission clamp (``obs.device``), and the column layouts
of the conformance ledger (``obs.histograms``) and the SLO window
(``obs.slo``) that the pull queue's host mirrors use."""
