"""Model configurations, UNet building blocks, UNet2DCondition and parameter conversion."""
