"""Explainers on the serving path: Grad-CAM on the image branch and
gradient SHAP over the fused embedding."""
