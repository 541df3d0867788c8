"""Device meshes of the port (co-resident CTAs on one card)."""
