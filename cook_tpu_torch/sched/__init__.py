"""Host-side staging of the fused cycle's wire (``fused``) and the split
match path's device dispatch (``matcher``)."""
