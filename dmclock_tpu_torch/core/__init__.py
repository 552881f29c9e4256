"""Core dmClock types for the PyTorch port (own copies; the port imports
nothing from ``dmclock_tpu``): the int64-ns time/tag constants
(``timebase``), ``ClientInfo`` (``qos``), ``Phase``/``ReqParams``
(``recs``), ``tag_calc`` (``tags``) and the queue API's ``AtLimit``,
``NextReqType`` and ``PullReq`` (``scheduler``)."""
