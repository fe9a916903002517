from sycl_ray_tracer_torch.utils.cli import main

raise SystemExit(main())
