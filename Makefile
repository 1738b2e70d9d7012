# Entry points. Measurements run on the GPU (see README, "Running").

.PHONY: test smoke bench suite scaling native

test:            ## CPU 8-device virtual-mesh suite (the kernel in interpret mode)
	python -m pytest tests/ -q

smoke:           ## one-card smoke on the GPU: every deployment vs its reference
	python chip_smoke.py

bench:           ## headline flips/s on the GPU, one JSON line
	python bench.py

suite:           ## full benchmark suite (writes visual_output/)
	python -m tsu_tpu.benchmarks.runner

scaling:         ## scaling rows on the visible devices
	python -m tsu_tpu.benchmarks.scaling

native:          ## build the native C++ library (otherwise built at first use)
	sh tsu_tpu/native/build.sh
