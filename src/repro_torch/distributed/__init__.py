"""The distributed layer: logical-axis sharding on a ``DeviceMesh``
(``sharding``), the int8 error-feedback all-reduce (``compression``) and
GPipe stages over point-to-point sends (``pipeline``)."""
