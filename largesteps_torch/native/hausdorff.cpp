// One-directional Hausdorff distance h(A, B) = max over vertices of A of
// the distance to surface B (BVH-accelerated point-to-triangle queries).
//
// Native equivalent of the reference's optional libigl dependency
// (figures/comparison/generate_data.py:14-17,86: the symmetric metric is
// hausdorff(va,fa,vb,fb) + hausdorff(vb,fb,va,fa), computed by the Python
// wrapper).  Same vertex-sampled approximation as igl::hausdorff.

#include <cstdint>
#include <vector>

#include "bvh.hpp"

using namespace lsgeom;

extern "C" {

double ls_hausdorff(const double* va, int nva,
                    const double* vb, int nvb, const int* fb, int nfb) {
  std::vector<V3> bverts(nvb);
  for (int i = 0; i < nvb; ++i)
    bverts[i] = {vb[3 * i], vb[3 * i + 1], vb[3 * i + 2]};
  std::vector<Tri> btris(nfb);
  for (int i = 0; i < nfb; ++i)
    btris[i] = {fb[3 * i], fb[3 * i + 1], fb[3 * i + 2]};
  BVH bvh;
  bvh.init(bverts, btris);

  double worst = 0.0;
  for (int i = 0; i < nva; ++i) {
    V3 p{va[3 * i], va[3 * i + 1], va[3 * i + 2]};
    V3 q = bvh.closest_point(p);
    double d2 = (q - p).norm2();
    if (d2 > worst) worst = d2;
  }
  return std::sqrt(worst);
}

}  // extern "C"
