"""Host-side staging of the fused cycle's wire (``fused``)."""
