"""The port's scheduling cycle: the production driver (``fused``:
``FusedCycleDriver`` and the wire staging), the split cycle's ranker
(``ranker``) and matcher (``matcher``, with the device dispatch), and
the host copies of the constraint compiler (``constraints``) and the
elastic-gang plane (``elastic``)."""
