"""Fleet-scale serving of the port: the request router, disaggregated
prefill/decode, the weight plane and the chaos injectors, own copies of
``move2kube_tpu/serving/fleet``.

Layering (no cycles): ``router`` and ``disagg`` sit above the engine
(:mod:`move2kube_tpu_torch.serving.engine`) and import it; ``weights``
and ``chaos`` are host code with no engine dependency. This
``__init__`` stays import-free.
"""
